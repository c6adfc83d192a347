"""The port's corpus harvests and cross-lingual augmentation against the
JAX package's, on the CPU.

The harvests run over a temporary tree of packages put on ``sys.path``:
docstrings, function source, markdown and the interleaved whole equal the
JAX package's. A package whose import raises is still harvested by the
port, and is not imported: the port finds files with ``find_spec`` (the
JAX package's ``__import__`` skips it). ``translate_en``, ``pick_lang`` and
``augment_queries`` give the JAX package's strings over the QA sheet's
questions in pt, es, fr and de.
"""

import sys

import pytest

from optimized_rag_tpu.eval.qa_sheet import QA_SHEET
from optimized_rag_tpu.models import corpus as jc
from optimized_rag_tpu.models import xlingual as jx
from optimized_rag_tpu_torch.models import corpus as pc
from optimized_rag_tpu_torch.models import xlingual as px

PARA = ("This paragraph explains how the index {w} its rows in blocks of "
        "sixty-four and why the scan reads each block once. It keeps a "
        "running list of the best scores and merges it at the end. ")


def _write(path, text):
    path.parent.mkdir(parents=True, exist_ok=True)
    path.write_text(text, encoding="utf-8")


@pytest.fixture
def packages(tmp_path, monkeypatch):
    """Three packages on sys.path: two plain ones with docstrings,
    functions, markdown and a tests/ directory (skipped), and one whose
    import raises."""
    for i, name in enumerate(("orag_pkg_a", "orag_pkg_b", "orag_pkg_bad")):
        root = tmp_path / name
        init = '"""' + PARA.format(w="packs") * 2 + '"""\n'
        if name.endswith("bad"):
            init += "raise RuntimeError('importing this package fails')\n"
        _write(root / "__init__.py", init)
        for j in range(3):
            body = "\n".join(
                f"def f{j}_{k}(x):\n    '''{PARA.format(w=f'{name} {j} {k}') * 2}'''"
                f"\n    y = x + {k}\n    return y * {j}\n" for k in range(4))
            _write(root / f"mod{j}.py",
                   f'"""{PARA.format(w=name)}\n\n{PARA.format(w="m")}"""\n'
                   + body)
        _write(root / "tests" / "test_x.py", f'"""{PARA.format(w="t")}"""')
        _write(root / "README.md", "\n\n".join(
            PARA.format(w=f"{name} {k}") for k in range(8)))
        _write(root / "sub" / "notes.rst", PARA.format(w="rst") * 3)
    monkeypatch.syspath_prepend(str(tmp_path))
    yield ["orag_pkg_a", "orag_pkg_b", "orag_pkg_bad"]
    for name in ("orag_pkg_a", "orag_pkg_b", "orag_pkg_bad"):
        sys.modules.pop(name, None)


def test_harvests_equal_jax(packages, monkeypatch):
    good = packages[:2]
    for kw in ({}, {"max_chunks": 5, "seed": 3}):
        assert pc.harvest_docstrings(good, **kw) == \
            jc.harvest_docstrings(good, **kw)
        assert pc.harvest_source_functions(good, **kw) == \
            jc.harvest_source_functions(good, **kw)
    assert len(pc.harvest_docstrings(good)) >= 6
    assert pc.harvest_docstrings(["no_such_package_anywhere"]) == []
    monkeypatch.setattr(jc, "_DEFAULT_PACKAGES", tuple(good))
    monkeypatch.setattr(pc, "_DEFAULT_PACKAGES", tuple(good))
    md = pc.harvest_markdown(max_chunks=20)
    assert md == jc.harvest_markdown(max_chunks=20) and md
    assert pc.harvest_all(max_chunks=40, seed=1) == \
        jc.harvest_all(max_chunks=40, seed=1)


def test_a_package_whose_import_raises_is_harvested_not_imported(packages):
    bad = ["orag_pkg_bad"]
    got = pc.harvest_docstrings(bad)
    assert got and "orag_pkg_bad" not in sys.modules
    assert pc.harvest_source_functions(bad)
    assert jc.harvest_docstrings(bad) == []       # __import__ raised
    both = pc.harvest_docstrings(packages)
    assert set(got) <= set(both)
    assert set(jc.harvest_docstrings(packages[:2])) <= set(both)


QUESTIONS = [item.question for item in QA_SHEET]


def test_block_walk_meets_every_definition_in_ast_walk_order():
    """``_walk_blocks`` meets the definitions ``ast.walk`` meets, in its
    order, over nested, conditional, ``try``, ``with`` and ``match``
    blocks and over every source file of both packages."""
    import ast
    import glob
    import os
    kinds = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)
    nested = (
        "def a():\n    def b():\n        class C:\n            def d(s): ...\n"
        "    return lambda: [x for x in ()]\n"
        "if x:\n    def e(): ...\nelse:\n    class F: ...\n"
        "try:\n    def g(): ...\nexcept E:\n    def h(): ...\n"
        "finally:\n    async def i(): ...\n"
        "with m() as n:\n    for k in ():\n        def j(): ...\n"
        "match v:\n    case 1:\n        def l(): ...\n"
        "while 0:\n    class M:\n        def n(s): ...\n")
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    sources = [nested] + [
        open(f, encoding="utf-8").read() for f in sorted(glob.glob(
            os.path.join(root, "optimized_rag_tpu*", "**", "*.py"),
            recursive=True))]
    for src in sources:
        tree = ast.parse(src)
        want = [n for n in ast.walk(tree) if isinstance(n, kinds)]
        assert [n for n in pc._walk_blocks(tree)
                if isinstance(n, kinds)] == want
    assert len([n for n in pc._walk_blocks(ast.parse(nested))
                if isinstance(n, kinds)]) == 13


@pytest.mark.parametrize("lang", ["pt", "es", "fr", "de"])
def test_translate_en_equals_jax(lang):
    assert len(QUESTIONS) >= 20
    for q in QUESTIONS + ["matrix unit size", "Vectorization capability"]:
        assert px.translate_en(q, lang) == jx.translate_en(q, lang), q


def test_pick_lang_and_augment_queries_equal_jax():
    spans = QUESTIONS + [q.lower()[:30] for q in QUESTIONS]
    for keep in (0.55, 0.0, 1.0):
        assert [px.pick_lang(s, keep) for s in spans] == \
            [jx.pick_lang(s, keep) for s in spans]
        assert px.augment_queries(spans, keep) == \
            jx.augment_queries(spans, keep)
    langs = {px.pick_lang(s) for s in spans}
    assert None in langs and len(langs) >= 4
