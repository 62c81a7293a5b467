"""The port's examples (``examples/torch/*.py``) against the reference's
(``examples/*.py``), on the CPU.

Each port example runs through its ``main(["--device", "cpu", ...])`` at
small arguments, and the reference's at the same ones:

* ``quickstart`` uses numpy models and the store only, so the same seeds
  give the same manifests: every line it prints equals the reference's
  but the last, which names its temporary directory;
* ``federated`` and ``finetune_cascade`` train with each package's own
  train step from each package's own random init, so their losses differ;
  the lines that do not depend on them (the rounds' clients, the rebuilt
  nodes, the lineage graph) must be equal, and the storage ratio above 1;
* ``serve_batched`` prints a ``(4, 16)`` batch of token ids in the
  vocabulary, in the reference's format.
"""

import io
import pathlib
import re
import runpy
import sys
import tempfile
from contextlib import redirect_stdout

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
EXAMPLES = ("quickstart", "serve_batched", "federated", "finetune_cascade")


def _port(name):
    return runpy.run_path(str(ROOT / "examples" / "torch" / f"{name}.py"),
                          run_name=f"port_{name}")


def _run_port(name, argv, tmp_path, monkeypatch):
    tmp_path.mkdir(exist_ok=True)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    buf = io.StringIO()
    with redirect_stdout(buf):
        _port(name)["main"](["--device", "cpu", *argv])
    return buf.getvalue()


def _run_reference(name, argv, tmp_path, monkeypatch):
    """The reference example run as a script with ``argv``."""
    tmp_path.mkdir(exist_ok=True)
    monkeypatch.setattr(tempfile, "tempdir", str(tmp_path))
    monkeypatch.setattr(sys, "argv", [f"{name}.py", *argv])
    buf = io.StringIO()
    with redirect_stdout(buf):
        runpy.run_path(str(ROOT / "examples" / f"{name}.py"),
                       run_name="__main__")
    return buf.getvalue()


def _graph_lines(out):
    """The ``lineage graph:`` block's lines."""
    lines = out.splitlines()
    start = lines.index("lineage graph:") + 1
    return [line for line in lines[start:] if line.startswith(("*", " "))]


@pytest.mark.parametrize("name", EXAMPLES)
def test_each_example_has_a_main_taking_argv(name):
    main = _port(name)["main"]
    assert main.__code__.co_varnames[:1] == ("argv",)
    assert main.__defaults__ == (None,)


def test_quickstart_prints_the_reference_figures(tmp_path, monkeypatch):
    port = _run_port("quickstart", [], tmp_path / "port", monkeypatch)
    ref = _run_reference("quickstart", [], tmp_path / "ref", monkeypatch)
    port_lines, ref_lines = port.splitlines(), ref.splitlines()
    assert port_lines[-1].startswith("(artifacts persisted under ")
    assert port_lines[:-1] == ref_lines[:-1]
    assert "ratio=2.77x" in port_lines[0]
    assert "diag: cold executed=3, warm cache-hit ratio=100%" in port_lines
    assert any(line.startswith("merge(edit_a, edit_b): no_conflict")
               for line in port_lines)


def test_serve_batched_prints_a_batch_of_tokens(tmp_path, monkeypatch):
    pattern = (r"generated \(4, 16\) tokens for 4 requests in [0-9.]+s "
               r"\([0-9]+ tok/s on CPU\)")
    port = _run_port("serve_batched", [], tmp_path, monkeypatch)
    ref = _run_reference("serve_batched", [], tmp_path, monkeypatch)
    for out in (port, ref):
        first, *rows = out.splitlines()
        assert re.fullmatch(pattern, first), first
        ids = [int(t) for t in " ".join(rows).replace("[", " ")
               .replace("]", " ").split()]
        assert len(ids) == 4 * 16 and all(0 <= t < 512 for t in ids)


def test_federated_builds_the_reference_lineage(tmp_path, monkeypatch):
    argv = ["--rounds", "2", "--clients", "3", "--sample", "2"]
    port = _run_port("federated", argv, tmp_path / "port", monkeypatch)
    ref = _run_reference("federated", argv, tmp_path / "ref", monkeypatch)
    rounds = [line for line in ref.splitlines() if line.startswith("round")]
    assert rounds == [line for line in port.splitlines()
                      if line.startswith("round")]
    assert _graph_lines(port) == _graph_lines(ref)
    (stored,) = [line for line in port.splitlines() if "models stored" in line]
    n, ratio = re.match(r"(\d+) models stored, ratio=([0-9.]+)x",
                        stored).groups()
    assert int(n) == 1 + 2 * (2 + 1) and float(ratio) > 1.0
    losses = re.findall(r"client\d+_r\d+: loss=([0-9.]+)", port)
    assert len(losses) == 4 and all(0 < float(v) < 10 for v in losses)


def test_finetune_cascade_rebuilds_every_task(tmp_path, monkeypatch):
    argv = ["--steps", "6", "--tasks", "2"]
    port = _run_port("finetune_cascade", argv, tmp_path / "port", monkeypatch)
    ref = _run_reference("finetune_cascade", argv, tmp_path / "ref",
                         monkeypatch)
    assert "      rebuilt: ['task0@v2', 'task1@v2']" in port.splitlines()
    assert _graph_lines(port) == _graph_lines(ref)
    steps = [line.split("…")[0] for line in port.splitlines()
             if line.startswith("[")]
    assert steps == [line.split("…")[0] for line in ref.splitlines()
                     if line.startswith("[")]
    ratios = re.findall(r"ratio=([0-9.]+)x", port)
    assert len(ratios) == 2 and all(float(r) > 1.0 for r in ratios)
