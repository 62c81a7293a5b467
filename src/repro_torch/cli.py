"""mgit — the command-line interface over the lineage graph (paper §3.1).

    python -m repro_torch.cli -C <repo_dir> <command> [...]

Commands (analogous to git's CLI, per the paper):
    log                         render the lineage graph
    show <node>                 node details (parents, versions, storage)
    diff <a> <b> [--mode]       structural/contextual diff between two models
    add-edge <x> <y>            provenance edge
    add-version-edge <x> <y>    versioning edge
    remove-node <x>             remove node + subtree
    test <node|--all> [--re P | --glob P]
                                run registered tests via a traversal
                                (one explicit pattern mode, regex or glob)
    param <node> <key>          materialize ONE parameter (lazy checkout):
                                prints its reconstruction plan + summary stats
    checkout <node>             batched full-model materialization through
                                the chain-folding engine (DESIGN.md §10):
                                prints per-param chain stats (hops decoded,
                                dequants applied, folds, zero-copy reads)
    stats                       storage statistics (ratio, dedup, objects,
                                packfiles, tensor + fold caches)
    gc                          collect unreferenced objects

Global storage knobs:
    --lzma-preset N             LZMA preset for newly committed delta blobs
                                (0 fastest ... 9 strongest; default 0 — see
                                bench_compression's preset sweep)
    --backend {cuda,ref}        where every store, pool, hub, clone and
                                trainer of the command runs: cuda (the
                                default) runs the storage kernels and the
                                models on the CUDA card and raises
                                KernelError when there is none; ref runs
                                the plain versions on the CPU

Collaboration commands (paper §5; DESIGN.md §8, §11):
    remote add <name> <url>     register a peer repository (url = directory
                                or an http(s):// hub daemon)
    remote list                 configured remotes
    remote remove <name>        unregister a remote
    push <remote> [--filter P] [--force]
                                ship the (fnmatch-filtered) lineage subgraph:
                                have/want negotiation transfers only objects
                                the remote is missing; a lineage conflict
                                aborts before publish unless --force; a
                                concurrent pusher is absorbed via the
                                409/etag retry loop (DESIGN.md §11.3)
    pull <remote> [--filter P]  fetch the (filtered) remote subgraph and
                                three-way merge it into the local lineage;
                                divergent models auto-merge when the §5
                                decision tree allows
    clone <url> <dest>          materialize a remote repo (directory or hub
                                url) into a fresh directory (sets up
                                'origin' tracking)
    fsck                        integrity pass: re-hash all CAS objects,
                                verify manifest closures, report dangling
                                refs / refcount drift / stale transfers

Hub commands (DESIGN.md §11; 'hub' namespace — the bare name 'serve' is
reserved for the inference engine in repro_torch/serve):
    hub serve [--host H] [--port N] [--token T] [--allow-quarantined]
                                serve THIS repo (-C) to HTTP clients:
                                threaded daemon, optimistic-swap publishes,
                                zero-copy ranged object reads, resumable
                                journalled transfers
    hub stats <url>             live counters of a running hub daemon

Serving commands (DESIGN.md §13; the inference tier over -C repo's store):
    serve <name>=<mode>:<target> [...] [--hub URL] [--host H] [--port N]
                                lineage-native model serving: one resident
                                chain base, per-endpoint derivative views
                                by fused delta application, hot-swapped on
                                lineage publish (local lineage.json etag,
                                or a hub's ETag'd GET /api/lineage with
                                --hub). Endpoint specs pin a branch
                                (prod=branch:main — head re-resolves, a
                                merge INTO the branch promotes), a node
                                (canary=node:m@v2), or a raw manifest ref.
                                Quarantined nodes never get traffic.

Observability commands (DESIGN.md §14):
    obs metrics                 print the process-wide metrics registry in
                                Prometheus text exposition format (counters
                                register at zero for a fresh process; run a
                                command under `obs trace` or scrape a live
                                daemon's /api/metrics for hot numbers)
    obs trace [--out F] [cmd ...]
                                run an mgit command with tracing enabled
                                (default: a chain-folded checkout sweep of
                                every stored node) and write the spans as
                                Chrome-trace/Perfetto JSON — load the file
                                at https://ui.perfetto.dev

Diagnostics commands (paper §4; DESIGN.md §9):
    diag run [node] [--pattern P] [--match-glob] [--jobs N] [--force]
             [--builtin]        memoized parallel test sweep: unchanged
                                models answer from the result ledger with
                                zero materializations (--builtin registers a
                                param-RMS probe per model type so the ledger
                                is exercisable without the Python API)
    diag blame <node> <test>    DAG-wide regression attribution: classify
                                each ancestor failure as introduced /
                                inherited / merge-emergent and report the
                                earliest failing frontier
    diag history <node> [test]  ledger entries across the node's version
                                chain (ModelHub-style evaluation history)
    diag gate-report            quarantined nodes + recorded regressions
"""

from __future__ import annotations

import argparse
import json
import os
import sys
from typing import Optional

import numpy as np

from repro_torch.common import bf16
from repro_torch.core import LineageGraph, bfs, module_diff
from repro_torch.store import ArtifactStore

BACKENDS = ("cuda", "ref")


def _backend(name: str) -> Optional[str]:
    """The ``backend`` argument of the port's stores, pools, hubs and
    clones for ``--backend name``: ``None`` for cuda, which makes each of
    them raise ``KernelError`` when there is no card."""
    return None if name == "cuda" else name


def _graph(repo: str, lzma_preset=None, chunk_threshold=None,
           backend: str = "cuda") -> LineageGraph:
    return LineageGraph(path=repo,
                        store=ArtifactStore(root=repo,
                                            lzma_preset=lzma_preset,
                                            chunk_threshold=chunk_threshold,
                                            backend=_backend(backend)))


def build_parser() -> argparse.ArgumentParser:
    ap = argparse.ArgumentParser(prog="mgit", description=__doc__,
                                 formatter_class=argparse.RawDescriptionHelpFormatter)
    ap.add_argument("-C", dest="repo", default=".", help="lineage repo directory")
    ap.add_argument("--lzma-preset", dest="lzma_preset", type=int,
                    default=None, metavar="N",
                    help="LZMA preset for new delta blobs (0..9; default 0)")
    ap.add_argument("--chunk-threshold", dest="chunk_threshold", type=int,
                    default=None, metavar="BYTES",
                    help="tensors at/above this size commit as content-"
                         "defined chunk objects (default 8 MiB; 0 disables "
                         "chunking)")
    ap.add_argument("--backend", default="cuda", choices=BACKENDS,
                    help="where the command's stores, pools, hubs, clones "
                         "and trainer run: cuda runs the kernels and models "
                         "on the CUDA card and raises KernelError without "
                         "one; ref runs the plain versions on the CPU")
    ap.add_argument("--dump-docs", action="store_true",
                    help="print the generated CLI reference "
                         "(docs/cli_torch.md) and exit")
    sub = ap.add_subparsers(dest="cmd", required=True)

    sub.add_parser("log", help="render the lineage graph")
    p = sub.add_parser("show", help="node details (parents, versions, storage)")
    p.add_argument("node", help="lineage node name (e.g. bert@v2)")
    p = sub.add_parser("diff",
                       help="structural/contextual diff between two models")
    p.add_argument("a", help="first node name")
    p.add_argument("b", help="second node name")
    p.add_argument("--mode", default="contextual",
                   choices=["structural", "contextual"],
                   help="matching mode (paper §3.2)")
    p = sub.add_parser("add-edge", help="add a provenance edge")
    p.add_argument("x", help="parent node")
    p.add_argument("y", help="child node")
    p = sub.add_parser("add-version-edge", help="add a versioning edge")
    p.add_argument("x", help="earlier version node")
    p.add_argument("y", help="later version node")
    p = sub.add_parser("remove-node", help="remove a node and its subtree")
    p.add_argument("x", help="node to remove")
    p = sub.add_parser("test",
                       help="run registered tests via a graph traversal")
    p.add_argument("node", nargs="?", default=None,
                   help="traversal start (default: whole graph)")
    grp = p.add_mutually_exclusive_group()
    grp.add_argument("--re", dest="pattern", default=None,
                     help="regex test-name filter")
    grp.add_argument("--glob", dest="glob_pattern", default=None,
                     help="fnmatch glob test-name filter")
    p = sub.add_parser("param",
                       help="materialize ONE parameter (lazy checkout)")
    p.add_argument("node", help="lineage node name")
    p.add_argument("key", help="flat parameter key (layer/param)")
    p = sub.add_parser("checkout",
                       help="batched full-model materialization "
                            "(chain-folding engine, DESIGN.md §10)")
    p.add_argument("node", help="lineage node name")
    p.add_argument("--jobs", type=int, default=None,
                   help="decode worker threads (default: store io_workers)")
    sub.add_parser("stats", help="storage statistics (ratio, dedup, caches)")
    sub.add_parser("gc", help="collect unreferenced objects")
    p = sub.add_parser("remote", help="manage peer repositories")
    p.add_argument("action", choices=["add", "list", "remove"],
                   help="what to do with the remote registry")
    p.add_argument("name", nargs="?", help="remote name (add/remove)")
    p.add_argument("url", nargs="?",
                   help="peer directory or http(s):// hub url (add)")
    p = sub.add_parser("push",
                       help="ship the lineage subgraph to a remote "
                            "(DESIGN.md §8, §11.3)")
    p.add_argument("remote", help="remote name, directory, or hub url")
    p.add_argument("--filter", default=None,
                   help="fnmatch node filter for a shallow push")
    p.add_argument("--force", action="store_true",
                   help="publish even on a lineage conflict (keeps pushed "
                        "versions)")
    p.add_argument("--include-quarantined", action="store_true",
                   help="ship nodes a test gate quarantined (excluded by default)")
    p = sub.add_parser("pull",
                       help="fetch a remote subgraph and three-way merge it")
    p.add_argument("remote", help="remote name, directory, or hub url")
    p.add_argument("--filter", default=None,
                   help="fnmatch node filter for a shallow pull")
    p = sub.add_parser("clone",
                       help="materialize a remote repo into a fresh directory")
    p.add_argument("url", help="peer directory or http(s):// hub url")
    p.add_argument("dest", help="destination directory (must be fresh)")
    p.add_argument("--filter", default=None,
                   help="fnmatch node filter for a shallow clone")
    sub.add_parser("fsck",
                   help="integrity pass: re-hash objects, closures, refcounts")
    p = sub.add_parser("diag",
                       help="memoized diagnostics: run/blame/history/"
                            "gate-report (DESIGN.md §9)")
    p.add_argument("action", choices=["run", "blame", "history", "gate-report"],
                   help="diagnostics subcommand")
    p.add_argument("node", nargs="?", default=None,
                   help="node scope (run) / target node (blame, history)")
    p.add_argument("test", nargs="?", default=None,
                   help="test name (blame) / filter (history)")
    p.add_argument("--pattern", default=None, help="test-name filter")
    p.add_argument("--match-glob", action="store_true",
                   help="interpret --pattern as an fnmatch glob (default: regex)")
    p.add_argument("--jobs", type=int, default=4)
    p.add_argument("--force", action="store_true",
                   help="bypass the result ledger (results are re-recorded)")
    p.add_argument("--builtin", action="store_true",
                   help="register the builtin param-RMS probe per model type")
    p.add_argument("--prefetch", action="store_true",
                   help="batch-materialize each model before its tests run "
                        "(chain-folded, threaded checkout; DESIGN.md §10.3)")
    p = sub.add_parser("obs",
                       help="offline observability: metrics registry dump / "
                            "traced command runs (DESIGN.md §14)")
    p.add_argument("action", choices=["metrics", "trace"],
                   help="observability subcommand")
    p.add_argument("--out", default=None, metavar="FILE",
                   help="trace output path (default: <repo>/trace.json)")
    p.add_argument("rest", nargs=argparse.REMAINDER, metavar="CMD",
                   help="mgit command to run under tracing (trace action; "
                        "default: a checkout sweep of every stored node)")
    p = sub.add_parser("hub", help="model-hub daemon (DESIGN.md §11, §16)")
    p.add_argument("action",
                   choices=["serve", "stats", "gc", "compact", "replica"])
    p.add_argument("url", nargs="?",
                   help="hub url (stats/gc/compact actions; omitted = run "
                        "gc/compact offline over the -C repo)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for hub serve / hub replica")
    p.add_argument("--port", type=int, default=8943,
                   help="bind port for hub serve / hub replica (0 picks an "
                        "ephemeral one)")
    p.add_argument("--token", default=None,
                   help="bearer token: required of clients (serve) / sent "
                        "to the hub (stats; also $MGIT_HUB_TOKEN)")
    p.add_argument("--allow-quarantined", action="store_true",
                   help="accept pushed nodes flagged quarantined instead of "
                        "rejecting them server-side")
    p.add_argument("--max-workers", type=int, default=None, metavar="N",
                   help="request worker-pool size (serve/replica; 0 = "
                        "unbounded thread-per-request compat mode)")
    p.add_argument("--queue-depth", type=int, default=None, metavar="N",
                   help="accepted-but-unserviced request backlog before the "
                        "hub sheds load with 503 + Retry-After")
    p.add_argument("--confirm-cycles", type=int, default=2, metavar="N",
                   help="hub gc: orphan confirmation cycles (1 = reclaim "
                        "on first sight; offline use only)")
    p.add_argument("--grace", type=int, default=1, metavar="N",
                   help="hub gc: cycles an imported-but-unpublished object "
                        "is protected from candidacy")
    p.add_argument("--primary", default=None, metavar="URL",
                   help="hub replica: primary hub to mirror (required)")
    p.add_argument("--sync-interval", type=float, default=5.0, metavar="S",
                   help="hub replica: seconds between mirror passes (0 = "
                        "sync only on POST /api/replica/sync)")
    p = sub.add_parser("serve",
                       help="lineage-native inference daemon (DESIGN.md "
                            "§13): one resident base, hot-swappable "
                            "branch-pinned endpoints")
    p.add_argument("endpoints", nargs="+", metavar="NAME=MODE:TARGET",
                   help="endpoint specs, e.g. prod=branch:main "
                        "canary=node:m@v2 pin=ref:m_<hash>")
    p.add_argument("--hub", default=None, metavar="URL",
                   help="watch this hub's ETag'd lineage instead of the "
                        "local lineage.json (store still reads -C repo)")
    p.add_argument("--token", default=None,
                   help="bearer token for --hub (also $MGIT_HUB_TOKEN)")
    p.add_argument("--host", default="127.0.0.1",
                   help="bind address for the serving daemon")
    p.add_argument("--port", type=int, default=8944,
                   help="bind port (0 picks an ephemeral one)")
    p.add_argument("--poll", type=float, default=1.0, metavar="S",
                   help="lineage watch interval in seconds")
    p.add_argument("--max-resident", type=int, default=8, metavar="N",
                   help="LRU cap on resident derivative views")
    p.add_argument("--budget-mb", type=int, default=None, metavar="MB",
                   help="byte budget over the views' private (non-aliased) "
                        "bytes; the pinned base is not counted")
    # a dest of its own: argparse writes a subparser's defaults over the
    # namespace, so a shared dest would drop the global --backend
    p.add_argument("--backend", dest="serve_backend", default=None,
                   choices=BACKENDS,
                   help="backend of the pool's delta application: cuda "
                        "(fused chain_apply kernel on the card) or ref "
                        "(host fold on the CPU); default: the global "
                        "--backend")
    p = sub.add_parser("train",
                       help="toy training run with continuous checkpointing "
                            "(DESIGN.md §15): every commit is an MGit "
                            "version node in -C repo")
    p.add_argument("--steps", type=int, default=20,
                   help="number of training steps to run")
    p.add_argument("--commit-every", type=int, default=1, metavar="N",
                   help="commit a checkpoint version every N steps "
                        "(the continuous-checkpointing cadence)")
    p.add_argument("--lossy-tier", action="store_true",
                   help="int8 error-feedback deltas with periodic exact "
                        "keyframes instead of lossless step deltas")
    p.add_argument("--keyframe-every", type=int, default=8, metavar="K",
                   help="lossy tier: every K-th commit is an exact keyframe")
    p.add_argument("--d-model", type=int, default=32,
                   help="toy model width")
    p.add_argument("--n-layers", type=int, default=2,
                   help="toy model depth")
    p.add_argument("--batch", type=int, default=4)
    p.add_argument("--seq", type=int, default=16)
    p.add_argument("--seed", type=int, default=0)
    return ap


def main(argv=None) -> int:
    argv = list(sys.argv[1:] if argv is None else argv)
    ap = build_parser()
    if "--dump-docs" in argv:
        # Intercepted pre-parse: the subcommand argument is required, and
        # docs generation must not depend on one.
        print(dump_docs(ap))
        return 0
    args = ap.parse_args(argv)

    if args.cmd == "obs":
        return _cmd_obs(args)
    if args.cmd == "hub":
        return _cmd_hub(args)
    if args.cmd == "serve":
        return _cmd_serve(args)
    if args.cmd == "train":
        return _cmd_train(args)
    if args.cmd == "clone":  # dest is the repo; don't touch args.repo
        from repro_torch import remote as rm
        report = rm.clone(args.url, args.dest, filter=args.filter,
                          backend=_backend(args.backend))
        print(json.dumps(report.to_json(), indent=1))
        return 0 if report.merge is None or not report.merge.conflicts else 1

    g = _graph(args.repo, lzma_preset=args.lzma_preset,
               chunk_threshold=args.chunk_threshold, backend=args.backend)

    if args.cmd == "log":
        print(g.log() or "(empty lineage graph)")
    elif args.cmd == "show":
        n = g.nodes[args.node]
        info = {"name": n.name, "model_type": n.model_type,
                "parents": n.parents, "children": n.children,
                "version_parents": n.version_parents,
                "version_children": n.version_children,
                "artifact_ref": n.artifact_ref, "metadata": n.metadata}
        if n.artifact_ref and g.store:
            m = g.store.get_manifest(n.artifact_ref)
            kinds = {}
            for e in m["params"].values():
                kinds[e["kind"]] = kinds.get(e["kind"], 0) + 1
            info["storage"] = {"depth": m["depth"], "entries": kinds}
        print(json.dumps(info, indent=1))
    elif args.cmd == "diff":
        d = module_diff(g.get_model(args.a), g.get_model(args.b),
                        mode=args.mode)
        print(json.dumps({
            "mode": d.mode, "divergence": d.divergence,
            "matched": len(d.matched_nodes),
            "add_nodes": d.add_nodes, "del_nodes": d.del_nodes,
            "add_edges": len(d.add_edges), "del_edges": len(d.del_edges),
        }, indent=1))
    elif args.cmd == "add-edge":
        g.add_edge(args.x, args.y)
        print(f"provenance edge {args.x} -> {args.y}")
    elif args.cmd == "add-version-edge":
        g.add_version_edge(args.x, args.y)
        print(f"version edge {args.x} -> {args.y}")
    elif args.cmd == "remove-node":
        g.remove_node(args.x)
        print(f"removed {args.x} (+subtree)")
    elif args.cmd == "test":
        it = bfs(g) if args.node is None else bfs(g, start=args.node)
        pattern, match = ((args.glob_pattern, "glob")
                          if args.glob_pattern is not None
                          else (args.pattern, "regex"))
        results = g.run_tests(it, pattern=pattern, match=match)
        print(json.dumps(results, indent=1) if results else
              "(no registered tests matched — register via the Python API)")
    elif args.cmd == "param":
        # Lazy single-parameter checkout: resolves the delta chain for ONE
        # tensor and materializes only that chain — never the full model.
        node = g.nodes[args.node]
        if node.artifact_ref is None or g.store is None:
            print(f"node {args.node!r} has no stored artifact")
            return 1
        try:
            plan = g.store.resolve_chain(node.artifact_ref, args.key)
        except KeyError:
            keys = sorted(g.store.get_manifest(node.artifact_ref)["params"])
            print(f"no param {args.key!r} in {args.node!r}; available: "
                  + ", ".join(keys[:8]) + (" ..." if len(keys) > 8 else ""))
            return 1
        value = g.store.materialize_param(node.artifact_ref, args.key,
                                          plan=plan)
        print(json.dumps({
            "node": args.node, "key": args.key,
            "shape": list(value.shape), "dtype": bf16.dtype_name(value),
            "l2_norm": float(np.linalg.norm(_float64(value))),
            "plan": {"base": plan.base_kind, "chain_depth": plan.depth},
            "bytes_materialized": g.store.io_stats["bytes_materialized"],
        }, indent=1))
    elif args.cmd == "checkout":
        # Batched full-model checkout: chain folding collapses same-eps
        # delta chains into one dequant per parameter; decode fans out
        # across the store's worker pool (DESIGN.md §10.3).
        import time as _time
        node = g.nodes[args.node]
        if node.artifact_ref is None or g.store is None:
            print(f"node {args.node!r} has no stored artifact")
            return 1
        g.store.reset_io_stats()
        t0 = _time.perf_counter()
        artifact = g.store.materialize_artifact(node.artifact_ref,
                                                max_workers=args.jobs)
        dt = _time.perf_counter() - t0
        print(json.dumps({
            "node": args.node, "params": len(artifact.params),
            "bytes": artifact.nbytes(), "seconds": round(dt, 4),
            "io": dict(g.store.io_stats),
            "zero_copy_gets": g.store.cas.stats["zero_copy_gets"],
        }, indent=1))
    elif args.cmd == "stats":
        print(json.dumps(g.store.stats(), indent=1))
    elif args.cmd == "gc":
        print(f"reclaimed {g.store.gc()} bytes")
    elif args.cmd == "remote":
        from repro_torch import remote as rm
        if args.action == "add":
            if not args.name or not args.url:
                print("usage: remote add <name> <url>")
                return 1
            rm.remote_add(args.repo, args.name, args.url)
            print(f"remote {args.name} -> {args.url}")
        elif args.action == "remove":
            rm.remote_remove(args.repo, args.name)
            print(f"removed remote {args.name}")
        else:
            print(json.dumps(rm.remote_list(args.repo), indent=1))
    elif args.cmd in ("push", "pull"):
        from repro_torch import remote as rm
        transport, name = rm.resolve_transport(
            args.repo, args.remote, backend=_backend(args.backend))
        state = rm.RemoteState(args.repo, name)
        if args.cmd == "push":
            report = rm.push(g, transport, filter=args.filter, state=state,
                             force=args.force,
                             include_quarantined=args.include_quarantined)
        else:
            report = rm.pull(g, transport, filter=args.filter, state=state)
        print(json.dumps(report.to_json(), indent=1))
        if args.cmd == "push" and not report.published:
            return 1
        return 1 if report.merge is not None and report.merge.conflicts else 0
    elif args.cmd == "fsck":
        from repro_torch.remote import LocalJournalStore
        roots = [n.artifact_ref for n in g.nodes.values() if n.artifact_ref]
        report = g.store.fsck(roots)
        report["in_flight_transfers"] = LocalJournalStore(
            args.repo).journal_list()
        print(json.dumps(report, indent=1))
        return 0 if report["ok"] else 1
    elif args.cmd == "diag":
        from repro_torch import diag
        runner = diag.DiagnosticsRunner(g, max_workers=args.jobs,
                                        prefetch=getattr(args, "prefetch",
                                                         False))
        if args.builtin:
            _register_builtin_probes(g)
        if args.action == "run":
            nodes = None if args.node is None else [g.nodes[args.node]]
            if not g.tests:
                print("(no registered tests — register via the Python API "
                      "or pass --builtin)")
                return 1
            report = runner.run(
                nodes=nodes, pattern=args.pattern,
                match="glob" if args.match_glob else "regex",
                force=args.force)
            print(json.dumps(report.to_json(), indent=1))
            return 1 if report.failures() else 0
        elif args.action == "blame":
            if not args.node or not args.test:
                print("usage: diag blame <node> <test>")
                return 1
            report = diag.blame(g, args.node, args.test, runner=runner)
            print(json.dumps(report.to_json(), indent=1))
            return 0 if report.status == diag.PASS else 1
        elif args.action == "history":
            if not args.node:
                print("usage: diag history <node> [test]")
                return 1
            entries = runner.history(args.node, args.test)
            print(json.dumps(entries, indent=1) if entries else
                  f"(no recorded results for {args.node!r})")
        else:  # gate-report
            print(json.dumps(diag.gate_report(g), indent=1) or "[]")
    return 0


def _cmd_obs(args) -> int:
    """`obs metrics` (registry dump) / `obs trace` (traced command run)."""
    from repro_torch.obs import render_prometheus, save_trace, tracing
    if args.action == "metrics":
        # opening a store registers the store's metric families
        _graph(args.repo, backend=args.backend)
        print(render_prometheus(), end="")
        return 0
    rest = [a for a in args.rest if a != "--"]
    # REMAINDER swallows options placed after the action; recover --out
    if len(rest) >= 2 and rest[0] == "--out":
        args.out, rest = rest[1], rest[2:]
    elif rest and rest[0].startswith("--out="):
        args.out, rest = rest[0].split("=", 1)[1], rest[1:]
    out = args.out or os.path.join(args.repo, "trace.json")
    with tracing():
        if rest:
            rc = main(["-C", args.repo, "--backend", args.backend] + rest)
        else:
            g = _graph(args.repo, backend=args.backend)
            refs = [(n.name, n.artifact_ref) for n in g.nodes.values()
                    if n.artifact_ref]
            for _, ref in refs:
                g.store.materialize_artifact(ref)
            print(f"traced a checkout sweep over {len(refs)} node(s)")
            rc = 0
    spans = save_trace(out)
    # stderr: the traced command owns stdout (JSON output stays pipeable)
    print(f"wrote {spans} span(s) to {out}", file=sys.stderr)
    return rc


def _cmd_hub(args) -> int:
    """`hub serve|stats|gc|compact|replica` (DESIGN.md §11, §16)."""
    pool_kw = {}
    if args.max_workers is not None:
        pool_kw["max_workers"] = args.max_workers
    if args.queue_depth is not None:
        pool_kw["queue_depth"] = args.queue_depth
    if args.action == "serve":
        from repro_torch.hub import HubService, make_server
        service = HubService(args.repo, token=args.token,
                             allow_quarantined=args.allow_quarantined,
                             backend=_backend(args.backend))
        server = make_server(service, host=args.host, port=args.port,
                             **pool_kw)
        names = ", ".join(service.repo_names())
        print(f"mgit hub: serving {service.root} at {server.url} "
              f"(repos: {names})"
              + (" [token auth]" if service.auth.enabled else ""), flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    if args.action == "replica":
        if not args.primary:
            print("usage: hub replica --primary URL [-C replica-dir]")
            return 1
        from repro_torch.hub.replica import serve_replica
        replica, server, _ = serve_replica(
            args.repo, args.primary, token=args.token,
            host=args.host, port=args.port,
            sync_interval_s=args.sync_interval,
            backend=_backend(args.backend))
        print(f"mgit hub replica: mirroring {args.primary} into "
              f"{replica.service.root} at {server.url}", flush=True)
        try:
            server.serve_forever()
        except KeyboardInterrupt:
            pass
        finally:
            server.server_close()
        return 0
    if args.action in ("gc", "compact"):
        if args.url:  # remote: ask a live hub to run its maintenance
            from repro_torch.remote.http import HttpTransport
            tr = HttpTransport(args.url, token=args.token)
            report = (tr.run_gc(confirm_cycles=args.confirm_cycles,
                                grace=args.grace)
                      if args.action == "gc" else tr.run_compact())
        else:  # offline: the hub dir with no live traffic -> no fences
            from repro_torch.hub import HubService
            from repro_torch.hub.gc import run_compaction, run_gc
            service = HubService(args.repo, allow_quarantined=True,
                                 backend=_backend(args.backend))
            report = (run_gc(service, confirm_cycles=args.confirm_cycles,
                             grace=args.grace)
                      if args.action == "gc" else run_compaction(service))
        print(json.dumps(report, indent=1))
        return 0
    if not args.url:
        print("usage: hub stats <url>")
        return 1
    from repro_torch.remote.http import HttpTransport
    print(json.dumps(HttpTransport(args.url, token=args.token).server_stats(),
                     indent=1))
    return 0


def _cmd_serve(args) -> int:
    """`serve`: blocking inference daemon over the -C repo's store."""
    from repro_torch.serve import (HubLineageSource, LineageWatcher,
                                   LocalLineageSource, ModelPool, Router,
                                   ServeApp, make_server)
    backend = _backend(args.serve_backend or args.backend)
    store = ArtifactStore(root=args.repo, backend=backend)
    pool = ModelPool(store, max_resident=args.max_resident,
                     budget_bytes=(args.budget_mb * (1 << 20)
                                   if args.budget_mb else None),
                     backend=backend)
    router = Router(pool, args.endpoints)
    token = args.token or os.environ.get("MGIT_HUB_TOKEN")
    source = (HubLineageSource(args.hub, token=token) if args.hub
              else LocalLineageSource(args.repo))
    watcher = LineageWatcher(source, router, interval_s=args.poll)
    watcher.poll()  # resolve every endpoint before accepting traffic
    app = ServeApp(router, pool, watcher)
    server = make_server(app, host=args.host, port=args.port)
    watcher.start()
    print(f"mgit serve: {len(router.endpoints)} endpoint(s) over "
          f"{source.describe()} at {server.url}", flush=True)
    for ep in router.endpoints.values():
        st = ep.stats()
        print(f"  {st['name']} -> {st['spec']} "
              f"(node={st['node']}, gate={st['gate']})", flush=True)
    try:
        server.serve_forever()
    except KeyboardInterrupt:
        pass
    finally:
        watcher.stop()
        server.server_close()
    return 0


def _cmd_train(args) -> int:
    """`train`: toy loop exercising the continuous-checkpointing path."""
    from repro_torch.models.config import ModelConfig
    from repro_torch.store.checkpoint import CKPT_STATS
    from repro_torch.train import Trainer
    cfg = ModelConfig(name="cli-train", family="dense",
                      n_layers=args.n_layers, d_model=args.d_model,
                      n_heads=2, n_kv_heads=2, d_ff=args.d_model * 2,
                      vocab_size=64, head_dim=args.d_model // 2,
                      dtype="float32", attn_chunk=16, remat="none")
    trainer = Trainer(cfg, batch=args.batch, seq=args.seq,
                      checkpoint_dir=args.repo, seed=args.seed,
                      commit_every=args.commit_every,
                      lossy_tier=args.lossy_tier,
                      keyframe_every=args.keyframe_every,
                      device="cpu" if args.backend == "ref" else None)
    history = trainer.run(args.steps)
    ckpt = trainer.ckpt
    ckpt.close()
    print(json.dumps({
        "steps": args.steps, "start_step": trainer.start_step,
        "final_loss": history["loss"][-1] if history["loss"] else None,
        "tier": ckpt.tier, "commit_every": trainer.checkpoint_every,
        "latest_step": ckpt.latest_step(),
        "ckpt": {k: int(CKPT_STATS[k]) for k in
                 ("saves", "commits", "coalesced", "leaves_skipped")},
    }, indent=1))
    return 0


# ---------------------------------------------------------------------------
# CLI reference generation (docs/cli_torch.md)
# ---------------------------------------------------------------------------


def _action_syntax(action: argparse.Action) -> str:
    """Deterministic syntax cell for one argparse action (no argparse
    formatter involved — their output wraps on terminal width, which would
    make the generated docs drift between environments)."""
    if not action.option_strings:
        name = action.metavar or action.dest
        if action.choices is not None and action.metavar is None:
            name = "{" + ",".join(str(c) for c in action.choices) + "}"
        if action.nargs in ("?", "*", argparse.REMAINDER):
            return f"[{name}]"
        return f"<{name}>"
    opts = ", ".join(action.option_strings)
    if action.nargs == 0:
        return f"`{opts}`"
    metavar = action.metavar or action.dest.replace("-", "_").upper()
    return f"`{opts} {metavar}`"


def _action_desc(action: argparse.Action) -> str:
    desc = " ".join((action.help or "").split())
    extras = []
    if action.choices is not None and action.option_strings:
        extras.append("one of: " + ", ".join(str(c) for c in action.choices))
    if (action.option_strings and action.nargs != 0
            and action.default not in (None, False, argparse.SUPPRESS)):
        extras.append(f"default: {action.default}")
    if extras:
        desc = (desc + " " if desc else "") + "(" + "; ".join(extras) + ")"
    return desc


def dump_docs(ap: argparse.ArgumentParser) -> str:
    """Render the complete CLI reference from the live argparse tree.

    ``docs/cli_torch.md`` is this function's output verbatim;
    ``tests/test_torch_cli.py`` regenerates it and fails on drift, so the
    reference can never fall behind the code."""
    sub = next(a for a in ap._actions
               if isinstance(a, argparse._SubParsersAction))
    out = [
        "# mgit — CLI reference",
        "",
        "<!-- GENERATED FILE, do not edit by hand.",
        "     Regenerate: PYTHONPATH=src python -m repro_torch.cli --dump-docs"
        " > docs/cli_torch.md",
        "     CI regenerates and diffs this file, failing on drift. -->",
        "",
        "Invocation: `python -m repro_torch.cli [global options] <command>"
        " [...]`",
        "",
        "## Global options",
        "",
        "| option | description |",
        "|---|---|",
    ]
    for action in ap._actions:
        if isinstance(action, (argparse._SubParsersAction,
                               argparse._HelpAction)):
            continue
        out.append(f"| {_action_syntax(action)} | {_action_desc(action)} |")
    out += ["", "## Commands", ""]
    for name, parser in sub.choices.items():
        actions = [a for a in parser._actions
                   if not isinstance(a, argparse._HelpAction)]
        positionals = [a for a in actions if not a.option_strings]
        usage = " ".join(["mgit", name]
                         + [_action_syntax(a) for a in positionals]
                         + (["[options]"]
                            if any(a.option_strings for a in actions)
                            else []))
        out += [f"### `{usage}`", ""]
        help_text = next((a.help for a in sub._choices_actions
                          if a.dest == name and a.help), None)
        if help_text:
            out += [" ".join(help_text.split()), ""]
        if actions:
            out += ["| argument | description |", "|---|---|"]
            for action in actions:
                out.append(f"| {_action_syntax(action)} "
                           f"| {_action_desc(action)} |")
            out.append("")
    out += [
        "## Command overview (from `mgit --help`)",
        "",
        "```text",
        (ap.description or "").strip(),
        "```",
        "",
    ]
    return "\n".join(out)


def _register_builtin_probes(g: LineageGraph) -> None:
    """One param-RMS probe per model type in the graph.

    A named module-level function (stable bytecode), so its ledger entries
    memoize across CLI invocations — the second `diag run --builtin` answers
    entirely from the store."""
    for mt in sorted({n.model_type for n in g.nodes.values()}):
        g.register_test_function(_param_rms, "builtin/param_rms", mt=mt)


def _param_rms(model) -> float:
    # its bytecode differs from the reference package's (the bf16 widening
    # of _float64), so a ledger entry of one package's probe is not a memo
    # hit for the other's: each executes it once
    total, count = 0.0, 0
    for key in model.params:
        v = _float64(model.params[key])
        total += float((v * v).sum())
        count += v.size
    return float(np.sqrt(total / max(count, 1)))


def _float64(value) -> np.ndarray:
    """``value`` as float64; a bf16 carrier through its exact values
    (``np.asarray`` would read its bits as integers)."""
    return np.asarray(bf16.widen(value) if bf16.is_bf16(value) else value,
                      dtype=np.float64)


if __name__ == "__main__":
    sys.exit(main())
