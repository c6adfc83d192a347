"""What the benchmark may import and read: no JAX, no JAX package, no old
benchmark folders; the reference nothing of the program."""

import ast
import os
import subprocess
import sys

from portbench import harness

PKG = harness.HERE


def modules():
    for d, _, files in os.walk(PKG):
        for f in files:
            if f.endswith(".py"):
                yield os.path.join(d, f)


def imported_tops(path):
    tree = ast.parse(open(path, encoding="utf-8").read())
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            yield from (a.name.split(".")[0] for a in node.names)
        elif isinstance(node, ast.ImportFrom) and node.module and \
                not node.level:
            yield node.module.split(".")[0]
        elif isinstance(node, ast.Call) and getattr(
                node.func, "attr", getattr(node.func, "id", "")) in (
                "import_module", "__import__") and node.args and \
                isinstance(node.args[0], ast.Constant):
            yield str(node.args[0].value).split(".")[0]


def test_no_module_imports_jax_or_the_jax_package():
    for path in modules():
        bad = set(imported_tops(path)) & set(harness.FORBIDDEN)
        assert not bad, (path, bad)


def test_reference_imports_nothing_of_the_program():
    ref = os.path.join(PKG, "reference")
    for name in os.listdir(ref):
        if name.endswith(".py"):
            tops = set(imported_tops(os.path.join(ref, name)))
            assert tops <= {"__future__", "math", "re", "numpy", "torch"}, \
                (name, tops)


def test_no_code_names_the_old_benchmark_folders():
    tests = os.path.join(PKG, "tests")
    for path in modules():
        if path.startswith(tests):
            continue
        tree = ast.parse(open(path, encoding="utf-8").read())
        docs = {id(n.body[0].value) for n in ast.walk(tree)
                if isinstance(n, (ast.Module, ast.FunctionDef,
                                  ast.ClassDef)) and n.body
                and isinstance(n.body[0], ast.Expr)
                and isinstance(n.body[0].value, ast.Constant)}
        for node in ast.walk(tree):
            if isinstance(node, ast.Constant) and isinstance(
                    node.value, str) and id(node) not in docs:
                assert "benchmarks" not in node.value, (path, node.value)


def test_loading_the_timed_path_loads_no_jax():
    code = (
        "import sys; sys.path.insert(0, %r)\n"
        "from portbench import harness, system, check, control, sweep, "
        "readers, trace\n"
        "import portbench.traffic.served, portbench.traffic.batch\n"
        "import optimized_rag_tpu_torch.serving, "
        "optimized_rag_tpu_torch.index.dense, "
        "optimized_rag_tpu_torch.models.convert\n"
        "for m in %r: harness.reader(m)\n"
        "print(harness.forbidden_loaded())\n"
    ) % (harness.ROOT, [m["name"] for m in harness.benchmark()["per_layer"]
                        + harness.benchmark()["end_to_end"]])
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", code], capture_output=True,
                         text=True, env=env, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip().splitlines()[-1] == "[]"
