"""``repro_torch/core`` is a copy of ``repro/core``: each module's code
equals its reference's after the import prefix ``repro.core`` is rewritten
to ``repro_torch.core``, so the reference's core tests and bbcheck rules
vouch for the copy too. The same holds for the pure-numpy data pipeline
(``data/pipeline.py``), whose batch sequence a training restore depends
on. Comments and docstrings are prose and are not
compared: the copy's carry no development-history tags (issue and change
numbers), which the reference's do. To refresh the copy after a change to
``repro/core``, copy each module with the prefix rewritten and take those
tags out of its prose."""
import ast
import re
from pathlib import Path

import pytest

SRC = Path(__file__).resolve().parents[1] / "src"
CORE = sorted(p.name for p in (SRC / "repro" / "core").glob("*.py"))


def code_of(text: str) -> str:
    """The module's syntax tree with every docstring dropped (comments are
    not in the tree), dumped without positions."""
    tree = ast.parse(text)
    for node in ast.walk(tree):
        body = getattr(node, "body", None)
        if (isinstance(node, (ast.Module, ast.ClassDef, ast.FunctionDef,
                              ast.AsyncFunctionDef)) and body
                and isinstance(body[0], ast.Expr)
                and isinstance(body[0].value, ast.Constant)
                and isinstance(body[0].value.value, str)):
            node.body = body[1:]
    return ast.dump(tree)


def test_copy_has_no_extra_modules():
    assert sorted(p.name for p in (SRC / "repro_torch" / "core").glob("*.py")) \
        == CORE


@pytest.mark.parametrize("name", CORE)
def test_core_module_is_a_verbatim_copy(name):
    ref = (SRC / "repro" / "core" / name).read_text()
    copy = (SRC / "repro_torch" / "core" / name).read_text()
    assert code_of(copy) == code_of(ref.replace("repro.core",
                                                "repro_torch.core"))
    assert not re.search(r"\bISSUE \d|\bPR \d", copy)


def test_data_pipeline_is_a_verbatim_copy():
    ref = (SRC / "repro" / "data" / "pipeline.py").read_text()
    copy = (SRC / "repro_torch" / "data" / "pipeline.py").read_text()
    assert code_of(copy) == code_of(ref)
    assert not re.search(r"\bISSUE \d|\bPR \d", copy)
