"""The benchmark runs only the port: no file of it imports JAX or the JAX
package (top-level names compared whole), and a run without a card gives
no result."""

import ast
import os
import subprocess
import sys

from conftest import BENCH, ROOT

BANNED = {"jax", "jaxlib", "flax", "clique_tpu"}


def _imports(path):
    with open(path) as fh:
        tree = ast.parse(fh.read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for a in node.names:
                yield a.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0 \
                and node.module:
            yield node.module.split(".")[0]


def test_no_file_imports_jax_or_the_jax_package():
    found = []
    for dirpath, _dirs, files in os.walk(BENCH):
        for f in files:
            if f.endswith(".py"):
                p = os.path.join(dirpath, f)
                found += [(p, m) for m in _imports(p) if m in BANNED]
    assert not found, found


def test_the_port_is_not_the_jax_package():
    assert "clique_tpu_torch".split(".")[0] not in BANNED


def test_run_without_a_card_fails(tmp_path):
    env = dict(os.environ, CUDA_VISIBLE_DEVICES="")
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "panel180.hmm", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, env=env, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_unknown_workload_fails():
    out = subprocess.run(
        [sys.executable, os.path.join(BENCH, "run.py"), "--workload",
         "no.such", "--seed", "1", "--seconds", "1", "--trace", "0"],
        cwd=ROOT, capture_output=True, text=True, timeout=300)
    assert out.returncode != 0 and out.stdout.strip() == ""


def test_banned_modules_seen_by_whole_name(monkeypatch):
    from benchlib import runner

    assert runner.banned_modules() == []
    monkeypatch.setitem(sys.modules, "clique_tpu_torch_extra", sys)
    assert runner.banned_modules() == []
    monkeypatch.setitem(sys.modules, "jaxlib.xla_client", sys)
    assert runner.banned_modules() == ["jaxlib"]
